"""The port's dry run and roofline (launch/dryrun.py, launch/costs.py,
launch/roofline.py, launch/mesh.py's production mesh and HW,
core/ensemble.lower_sharded_ensemble) on the CPU.

  - For a reduced config of each family and each of train, prefill and
    decode, the dry run on fake tensors counts what the same step counts
    run for real: its FLOPs equal FlopCounterMode's on the real step, its
    argument bytes the real trees' bytes, its eager bytes and its temp peak
    the cost counter's readings on the real step (the same byte rules, the
    same weakref tracker). Exact: the same aten ops run on both sides.
  - The byte rules against a count by hand: views move nothing, an
    out-of-place product reads its operands and writes its result, an
    in-place op reads and writes its mutated operand, a broadcast operand
    counts its elements once.
  - A hand-written kernel's wrapper on fake CUDA tensors launches nothing:
    the library is never built or loaded (_build.load raises here), the
    launch counters of the card stay as they were, and the cost counter
    gets one launch with the kernel's formula FLOPs and bytes. The model's
    attention routes fake CUDA q / k / v to it. (A whole model on fake CUDA
    tensors needs PyTorch built for CUDA: the CPU build's indexing asks for
    a CUDA device guard. tests/test_torch_cuda.py runs a whole fake-CUDA
    prefill on the card.)
  - The sharded ensemble's dry run on a fake (2, 2) mesh counts as many
    all-gathers as api.sharded.GATHERS, with each result's bytes.
  - The production mesh is (32, 8); h2o-danube's decode_32k cell runs
    tensor parallel on it (--device cpu): a rank's argument bytes are its
    parameter and cache blocks' and its rows', its all-reduces on "model"
    the hand count (the embedding, each layer's attention and MLP, the
    greedy token's two), no other collective; an MLA cell passes
    tp.check_supported on it, and on a model axis of 3, which divides none
    of its heads, raises NotImplementedError before any process group; no
    process group is left behind; the production reservoir dry run (N = 16 384,
    E = 8 192, 2 steps) completes in a subprocess.
  - The roofline's MODEL_FLOPS equal the reference's formulas
    (repro.models.counting and its inline prefill formula), and its terms
    the counts over HW's rates.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.models import counting as ref_counting
from repro_torch import tree
from repro_torch.api import sharded
from repro_torch.configs import SHAPES, ShapeCell, get_config, reduce_config
from repro_torch.core.constants import STOParams
from repro_torch.core.ensemble import lower_sharded_ensemble
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, sto_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import costs, dryrun, roofline, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, build_model, make_input_specs
from repro_torch.models.transformer import TensorSpec
from repro_torch.train import train_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = (
    "h2o-danube-1.8b",  # dense
    "qwen2-moe-a2.7b",  # MoE
    "deepseek-v2-lite-16b",  # MLA
    "jamba-1.5-large-398b",  # Mamba + attention hybrid
    "xlstm-125m",  # xLSTM
    "whisper-base",  # encoder-decoder
    "llava-next-mistral-7b",  # embedding input
)
KINDS = ("train", "prefill", "decode")
SEQ, BATCH, ENC_SEQ = 16, 2, 16


def _real_batch(specs, rng):
    """A batch of the specs' shapes from a numpy generator: token ids in
    [0, 64), floats normal; the loss mask ones, decode positions SEQ - 1."""

    def make(path, spec):
        if isinstance(spec, TensorSpec):
            if spec.dtype.is_floating_point:
                mask = path.endswith("loss_mask")
                x = np.ones(spec.shape) if mask else rng.normal(size=spec.shape)
                return torch.as_tensor(x, dtype=torch.float32).to(spec.dtype)
            if path == "/pos":
                return torch.full(spec.shape, SEQ - 1, dtype=spec.dtype)
            return torch.as_tensor(rng.integers(0, 64, spec.shape), dtype=spec.dtype)
        if isinstance(spec, dict):
            return {k: make(f"{path}/{k}", v) for k, v in spec.items()}
        return [make(f"{path}/{i}", v) for i, v in enumerate(spec)]

    return make("", specs)


def _real_step(cfg, cell):
    """(step function, its real arguments) on the CPU."""
    rng = np.random.default_rng(0)
    batch = _real_batch(make_input_specs(cfg, cell, ENC_SEQ), rng)
    if cell.kind == "train":
        fn, opt, model = steps.make_train_step(cfg, device="cpu")
        params = model.init(0)
        return fn, (params, opt.init(params, device="cpu"), batch,
                    torch.zeros((), dtype=torch.int64))
    prefill, decode = steps.make_serve_steps(cfg, device="cpu")
    params = build_model(cfg, "cpu").init(0)
    return prefill if cell.kind == "prefill" else decode, (params, batch)


def _bytes(args):
    return sum(t.numel() * t.element_size() for a in args for t in tree.leaves(a))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_counts_the_real_step(arch, kind):
    cfg = reduce_config(get_config(arch))
    cell = ShapeCell(kind, SEQ, BATCH, kind)
    fake = dryrun.lower_step(cfg, cell, device="cpu", enc_seq=ENC_SEQ)
    fn, args = _real_step(cfg, cell)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    fn, args = _real_step(cfg, cell)  # fresh state: the train step updates in place
    _, real = costs.measure(fn, *args)
    assert fake["hlo_flops"] > 0
    assert fake["hlo_flops"] == counter.get_total_flops() == real["hlo_flops"]
    assert fake["argument_size_in_bytes"] == _bytes(args) == real["argument_size_in_bytes"]
    assert fake["hlo_bytes"] == real["hlo_bytes"] > 0
    assert fake["temp_size_in_bytes"] == real["temp_size_in_bytes"] > 0
    assert not fake["kernels"] and not any(c["count"] for c in fake["collectives"].values())


def test_eager_bytes_by_hand():
    a, b, c, bias = torch.ones(8, 16), torch.ones(16, 4), torch.ones(8, 16), torch.ones(4)

    def step(a, b, c, bias):
        v = a.view(16, 8).t().expand(2, 8, 16)  # views: nothing moves
        y = a @ b  # reads a and b, writes y
        z = y + bias.expand(8, 4)  # reads y and bias's 4 elements once, writes z
        a.add_(c)  # reads a and c, writes a
        return v, z

    _, rec = costs.measure(step, a, b, c, bias)
    f32 = 4
    mm = f32 * (8 * 16 + 16 * 4 + 8 * 4)
    add = f32 * (8 * 4 + 4 + 8 * 4)
    add_ = f32 * (8 * 16 + 8 * 16 + 8 * 16)
    assert rec["top_bytes"] == {"mm": mm, "add": add, "add_": add_}
    assert rec["hlo_bytes"] == mm + add + add_
    assert rec["argument_size_in_bytes"] == f32 * (3 * 8 * 16 + 16 * 4 - 8 * 16 + 4)
    assert rec["output_size_in_bytes"] == f32 * (8 * 16 + 8 * 4)  # a's storage and z's
    assert rec["temp_size_in_bytes"] == f32 * 2 * 8 * 4  # y and z live at once
    assert rec["hlo_flops"] == 2.0 * 8 * 16 * 4  # FlopCounterMode counts the product only


def _no_build(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded in a dry run")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("d", [32, 128])
def test_fake_cuda_attention_counts_flash(monkeypatch, d):
    """The model's attention call on fake CUDA q / k / v (a prefill's: B 2,
    64 positions, GQA group 2, a window of 16) reaches the flash wrapper,
    which reports one launch at the band's FLOPs and never builds."""
    _no_build(monkeypatch)
    before = dict(_build.LAUNCHES)
    with dryrun.fake_mode(), torch.no_grad():
        q = torch.empty(2, 64, 4, d, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 64, 2, d, dtype=torch.bfloat16, device="cuda")
        out, rec = costs.measure(attention.grouped_attend, q, k, k, causal=True, window=16)
    assert out.shape == q.shape and out.device.type == "cuda"
    flops = 4.0 * 2 * 4 * d * fa.band_pairs(64, 64, True, 16)
    assert rec["kernels"] == {"flash_attention": {
        "launches": 1, "flops": flops, "bytes": (2 * q.numel() + 2 * k.numel()) * 2}}
    assert rec["flops"]["bf16"] >= flops
    assert _build.LAUNCHES == before


def test_band_pairs_against_a_mask():
    for sq, sk, causal, window in ((5, 9, True, 0), (9, 9, True, 4), (7, 7, False, 0),
                                   (6, 11, True, 3), (4, 4, False, 2)):
        qi = np.arange(sq)[:, None] + (sk - sq)
        ki = np.arange(sk)[None, :]
        mask = np.ones((sq, sk), bool)
        if causal:
            mask &= ki <= qi
        if window:
            mask &= ki > qi - window
        assert fa.band_pairs(sq, sk, causal, window) == int(mask.sum())


def test_fake_cuda_sto_kernels_count(monkeypatch):
    """rk4_chunk, field_tiled (bf16 W: with round_bf16) and tm_delay_line on
    fake CUDA operands: one recorded launch each, chip_smoke.py's bound
    formulas, nothing built."""
    _no_build(monkeypatch)
    n, e, k_ticks, hold = 128, 64, 3, 2
    before = dict(_build.LAUNCHES)
    with dryrun.fake_mode():
        f32 = dict(dtype=torch.float32, device="cuda")
        m = torch.empty(3, n, e, **f32)
        w = torch.empty(n, n, **f32)
        p = torch.empty(sto_step.NP, e, **f32)
        h = torch.empty(k_ticks, n, e, **f32)
        mask = torch.empty(k_ticks, e, **f32)
        plane = torch.empty(n, e, **f32)
        w16 = torch.empty(n, n, dtype=torch.bfloat16, device="cuda")
        _, rec = costs.measure(sto_step.rk4_chunk, m, w, p, 1e-11, hold, h, mask)
        _, rec_f = costs.measure(sto_step.field_tiled, m, plane, m, w16, p, 0.5e-11, h_in=plane)
        _, rec_d = costs.measure(sto_step.tm_delay_line, m, plane, p, 1e-11, hold)
    evals = 4 * hold * k_ticks
    chunk = rec["kernels"]["rk4_chunk"]
    assert chunk["launches"] == 1 and chunk["flops"] == (2.0 * n * n * e + 60 * n * e) * evals
    assert chunk["bytes"] == 4 * (n * n + 2 * 3 * n * e + sto_step.NP * e + 2 * k_ticks * n * e
                                  + k_ticks * e)
    assert rec_f["kernels"]["field_tiled"]["launches"] == 1
    assert rec_f["kernels"]["round_bf16"]["launches"] == 1
    assert rec_f["flops"]["bf16"] == 2.0 * n * n * e
    assert rec_d["kernels"]["tm_delay_line"]["flops"] == sto_step.STEP_OPS * n * hold * e
    assert _build.LAUNCHES == before


def test_sharded_ensemble_dry_run_gathers():
    n, e, n_steps = 64, 8, 3
    with dryrun.fake_world(4):
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        g0 = sharded.GATHERS["all_gather"]
        with dryrun.fake_mode():
            low = lower_sharded_ensemble(mesh, n=n, e=e, dt=1e-11, n_steps=n_steps,
                                         dtype=torch.float32, device="cpu")
            assert low.func is sharded.integrate_sharded
            _, rec = costs.measure(low.func, *low.args, mesh=mesh, **low.keywords)
        gathers = sharded.GATHERS["all_gather"] - g0
    assert not dist.is_initialized()
    coll = rec["collectives"]["all-gather"]
    # a stage gathers m^x (E/2, N); the result m (E, N, 3) over data, then model
    stage = (e // 2) * n * 4
    assemble = e * (n // 2) * 3 * 4 + e * n * 3 * 4
    assert coll["count"] == gathers == 4 * n_steps + 2
    assert coll["bytes"] == 4 * n_steps * stage + assemble
    assert rec["collective_bytes_by_dim"] == {"model": 4 * n_steps * stage + e * n * 3 * 4,
                                              "data": e * (n // 2) * 3 * 4}
    # every rank holds the global arguments (ROADMAP item 12's open part)
    assert rec["argument_size_in_bytes"] == 4 * (len(STOParams._fields) * e + n * n + e * n * 3)


def test_production_mesh():
    with dryrun.fake_world(256):
        mesh = mesh_mod.make_production_mesh()
        assert tuple(mesh.shape) == (32, 8)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
    with dryrun.fake_world(512):
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
        assert tuple(mesh.shape) == (2, 32, 8)
    assert not dist.is_initialized()


def test_production_lm_cell_waits_on_13b():
    """A dense production cell runs tensor parallel (model axis 8);
    deepseek's MLA cell is laid out there too (item 13j), and refused on a
    model axis of 3 before any process group."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import transformer

    arch, cell = "h2o-danube-1.8b", SHAPES["decode_32k"]
    rec = dryrun.lower_cell(arch, "decode_32k", multi_pod=False, device="cpu")
    assert not dist.is_initialized()
    cfg = get_config(arch)
    mesh = shd.AbstractMesh((32, 8), ("data", "model"))
    template = transformer.param_template(cfg)
    specs = shd.param_specs(mesh, template)

    def nbytes(shape, dtype):
        return math.prod(shape) * dtype.itemsize

    params = sum(nbytes(tp.block_shape(t.shape, s, mesh), t.dtype)
                 for t, s in zip(tree.leaves(template), tree.leaves(specs)))
    rows = cell.global_batch // 32
    caches = transformer.cache_specs(cfg, rows, cell.seq_len, mesh=shd.AbstractMesh(
        (1, 8), ("data", "model")))  # the rank's rows, its kv heads
    assert caches["stack"][0]["self"]["k"].shape == (24, rows, cell.seq_len, 1, 80)
    cache = sum(nbytes(c.shape, c.dtype) for c in tree.leaves(caches))
    assert rec["argument_size_in_bytes"] == params + cache + 2 * rows * 4  # + tokens, pos
    reduces = 1 + 2 * cfg.num_layers + 2  # embedding; attention, MLP; greedy token
    assert rec["collectives"]["all-reduce"]["count"] == reduces
    assert {k: v["count"] for k, v in rec["collectives"].items() if v["count"]} == {
        "all-reduce": reduces}
    assert set(rec["collective_bytes_by_dim"]) == {"model"}
    tp.check_supported(get_config("deepseek-v2-lite-16b"), mesh, serving=True)
    with pytest.raises(NotImplementedError, match="not a multiple of it"):
        dryrun.lower_cell("deepseek-v2-lite-16b", "decode_32k", multi_pod=False, device="cpu",
                          mesh_override=((32, 3), ("data", "model")))
    assert not dist.is_initialized()


def test_fake_world_refuses_another_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="makes its own fake one"):
            with dryrun.fake_world(4):
                pass
    finally:
        dist.destroy_process_group()


def test_data_parallel_step_all_reduces():
    """A (2, 1) mesh's train step: one all-reduce of the mask sum, then the
    loss and every gradient leaf, as train_loop.COLLECTIVES counts them,
    each on the data group; the rank holds half the rows."""
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    cell = ShapeCell("train", SEQ, 4, "train")
    before = train_loop.COLLECTIVES["all_reduce"]
    with dryrun.fake_world(2):
        mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), device_type="cpu")
        rec = dryrun.lower_step(cfg, cell, mesh, device="cpu")
    leaves = len(tree.leaves(build_model(cfg, "cpu").init(0)))
    reduces = rec["collectives"]["all-reduce"]
    assert reduces["count"] == train_loop.COLLECTIVES["all_reduce"] - before == 2 + leaves
    assert set(rec["collective_bytes_by_dim"]) == {"data"}
    whole = dryrun.lower_step(cfg, cell, device="cpu")
    batch_bytes = 4 * (3 * 4 * SEQ)  # tokens, labels, loss mask: 4 rows of 4-byte entries
    assert whole["argument_size_in_bytes"] - rec["argument_size_in_bytes"] == batch_bytes // 2


_RESERVOIR = r"""
import json
from repro_torch.launch import dryrun
recs = {v: dryrun.run_reservoir_dryrun(False, v, n_steps=2, device="cpu")
        for v in ("base", "bf16gather", "eonly")}
print("JSON:" + json.dumps(recs))
"""


def test_production_reservoir_dry_run():
    """The reference's three variants on the (32, 8) mesh, 2 RK4 steps."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _RESERVOIR], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("JSON:")][-1][5:])
    n, e = 16_384, 8_192
    base, bf16, eonly = recs["base"], recs["bf16gather"], recs["eonly"]
    assert base["devices"] == 256 and base["mesh"] == "pod32x8"
    # every rank holds the global arguments
    assert base["argument_size_in_bytes"] == 4 * (len(STOParams._fields) * e + n * n + e * n * 3)
    # 2 steps x 4 stages of m^x (E / 32 lanes, N), then the result m over
    # data and over model
    stage, assemble = (e // 32) * n, e * (n // 8) * 3 * 4 + e * n * 3 * 4
    for rec, width in ((base, 4), (bf16, 2)):
        gathers = rec["collectives"]["all-gather"]
        assert gathers["count"] == 2 * 4 + 2
        assert gathers["bytes"] == 2 * 4 * stage * width + assemble
    # the coupling product of a stage: the rank's N / 8 rows x E / 32 lanes
    assert base["flops"]["f32"] == 2 * 4 * 2.0 * (n // 8) * n * (e // 32)
    # E over all 256 ranks, W whole: no stage gather, the product N x N x E / 256
    assert eonly["collectives"]["all-gather"]["count"] == 2
    assert eonly["flops"]["f32"] == 2 * 4 * 2.0 * n * n * (e // 256)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "gemma-7b"])
def test_model_flops_are_the_reference_formulas(arch, shape):
    cfg, ref = get_config(arch), ref_get_config(arch)
    cell = SHAPES[shape]
    if cell.kind == "train":
        want = ref_counting.train_step_flops(ref, cell.global_batch, cell.seq_len)
    elif cell.kind == "decode":
        want = ref_counting.decode_step_flops(ref, cell.global_batch, cell.seq_len)
    else:  # the reference's inline formula (launch/roofline.py there)
        want = 2.0 * ref.active_param_count() * cell.global_batch * cell.seq_len
        attn_layers = sum(1 for s in ref.layer_kinds() if s.mixer in ("attn", "swa", "mla"))
        win = ref.sliding_window or 0
        s_eff = min(cell.seq_len, win) if win else cell.seq_len
        want += (2.0 * attn_layers * cell.global_batch * cell.seq_len * s_eff
                 * ref.num_heads * ref.head_dim)
    assert roofline.model_flops(cfg, cell) == want


def test_roofline_terms(tmp_path, monkeypatch):
    """analyze_cell on a (2, 1) mesh record: each term the counts over HW's
    rates (data-group bytes on the network), the dominant the largest."""
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    cell = ShapeCell("train", SEQ, 4, "train")
    with dryrun.fake_world(2):
        mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), device_type="cpu")
        rec = dryrun.lower_step(cfg, cell, mesh, device="cpu")
    rec.update(arch="h2o-danube-1.8b", shape="train_4k", mesh="mesh2x1", devices=2)
    monkeypatch.setattr(roofline, "OUT_DIR", tmp_path)
    (tmp_path / "h2o-danube-1.8b_train_4k_mesh2x1.json").write_text(json.dumps(rec))
    got = roofline.analyze_cell("h2o-danube-1.8b", "train_4k", "mesh2x1")
    hw = mesh_mod.HW
    assert got["t_compute_s"] == (rec["flops"]["bf16"] / hw["peak_flops_bf16"]
                                  + rec["flops"]["f32"] / hw["peak_flops_f32"])
    assert got["t_memory_s"] == rec["hlo_bytes"] / hw["hbm_bw"]
    assert got["t_collective_s"] == rec["collective_bytes_by_dim"]["data"] / hw["net_bw"] > 0
    terms = {k: got[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    full = get_config("h2o-danube-1.8b")
    assert got["model_flops_dev"] == roofline.model_flops(full, SHAPES["train_4k"]) / 2
    assert math.isclose(got["useful_ratio"], got["model_flops_dev"] / rec["hlo_flops"])
    with pytest.raises(FileNotFoundError):
        roofline.analyze_cell("h2o-danube-1.8b", "decode_32k", "mesh2x1")


def test_hw_variants():
    assert mesh_mod.hw_for("NVIDIA H100 80GB HBM3") is mesh_mod.HW
    assert mesh_mod.hw_for("NVIDIA H100 PCIe")["hbm_bw"] == 2.0e12
    assert mesh_mod.hw_for("NVIDIA H100 NVL")["peak_flops_bf16"] == 835e12


def test_cuda_is_refused_outside_a_dry_run():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with FakeTensorMode(), pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")  # another FakeTensorMode is not a dry run's
    with dryrun.fake_mode():
        assert resolve_device("cuda").type == "cuda"
