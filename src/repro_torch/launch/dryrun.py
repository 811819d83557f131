"""Dry run: every (architecture x input shape) cell, and the paper's own
reservoir workload, run once on fake tensors over a fake process group, with
its per-rank FLOPs, bytes, memory and collectives counted (launch/costs.py)
and nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
        --shape decode_32k --mesh-shape 4x1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reservoir --variant bf16gather

The counterpart of the reference's launch/dryrun.py, which lowers and
compiles each cell with XLA over 512 virtual CPU devices. Here a cell's step
(launch/steps.py: the train step with its optimizer, microbatches and remat,
or the prefill or decode step) runs eagerly under FakeTensorMode: tensors
carry shapes, dtypes and a device but no memory, so a 398 B-parameter model
costs nothing. The process is rank 0 of a fake process group
(torch.testing's FakeStore and "fake" backend) of the mesh's size: its
collectives return at once and are counted. A cell's record keeps the
reference's keys where the quantity exists in the port: argument / output /
temp bytes, hlo_flops and hlo_bytes (eager aten counts, not HLO), and the
collectives per kind.

The port's layouts are its own: a mesh's "model" axis wider than 1 raises
NotImplementedError (ROADMAP queue 1 item 13b, tensor-parallel training), so
an LM cell runs on the production mesh only once 13b lands and today runs on
a mesh whose model axis is 1 (`mesh_override`). Parameters and optimizer
state are whole on every rank (data parallelism), the batch's rows split
over ("pod", "data") as `distributed.sharding.batch_specs` lays them out.
The reservoir runs on the production mesh: its sharded plans split N over
"model" (api/sharded.py), and take global tensors on every rank, which its
argument bytes show.

Entry points default to device="cuda": fake CUDA tensors, the card's path
(the flash kernel's wrapper reports its launches and FLOPs, never building
or launching it); device="cpu" is the CPU path (the kernels' plain
versions). A fake-CUDA train step needs PyTorch built for CUDA (autograd
asks the device for a guard). Records go to experiments/dryrun_torch/.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch import tree
from repro_torch.configs import SHAPES, ShapeCell, cells_for, get_config, list_configs
from repro_torch.core.ensemble import lower_sharded_ensemble
from repro_torch.device import dry_run_mode
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costs as costs_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import make_input_specs, transformer
from repro_torch.models.transformer import TensorSpec
from repro_torch.train.train_loop import DataParallel

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# global-batch microbatch sizes for the train cells, the reference's values:
# its step runs global_batch // MICROBATCH[arch] microbatches; here each rank
# runs as many, each of its rows' share
MICROBATCH = {
    "command-r-plus-104b": 32,
    "jamba-1.5-large-398b": 32,
    "gemma-7b": 64,
    "llava-next-mistral-7b": 64,
    "phi4-mini-3.8b": 64,
    "deepseek-v2-lite-16b": 64,
    "qwen2-moe-a2.7b": 64,
    "h2o-danube-1.8b": 64,
    "whisper-base": 128,
    "xlstm-125m": 128,
}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x32x8" if multi_pod else "pod32x8"


def mesh_tag(shape) -> str:
    """A record's mesh name for a mesh of `shape` that is not a production
    mesh (a mesh_override)."""
    return "mesh" + "x".join(str(n) for n in shape)


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of `size` ranks:
    collectives run nowhere and return at once. The group is destroyed on
    exit; a process group already initialised is refused."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError(
            f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
            f"initialised; a dry run makes its own fake one"
        )
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


fake_mode = dry_run_mode


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device; got {dev}")
    return dev


def _local_shape(shape, layout, mesh):
    """A rank's block shape of a global `shape` under a layout tuple."""
    if mesh is None:
        return tuple(shape)
    out = list(shape)
    for i, axes in enumerate(layout):
        if axes is not None:
            out[i] //= shd.axis_size(mesh, axes)
    return tuple(out)


def _empty(specs, device, mesh=None):
    """Tensors of a TensorSpec tree's shapes on `device` (fake inside
    fake_mode), each rank's rows where a mesh is given. Integer leaves are
    zeros (token ids and positions in range); others are uninitialised."""
    layouts = None if mesh is None else shd.batch_specs(mesh, specs)

    def make(spec, layout):
        shape = _local_shape(spec.shape, layout, mesh)
        if spec.dtype.is_floating_point:
            return torch.empty(shape, dtype=spec.dtype, device=device)
        return torch.zeros(shape, dtype=spec.dtype, device=device)

    def walk(spec, layout):
        if isinstance(spec, TensorSpec):
            return make(spec, layout)
        if isinstance(spec, dict):
            return {k: walk(v, None if layout is None else layout[k]) for k, v in spec.items()}
        return [walk(v, None if layout is None else layout[i]) for i, v in enumerate(spec)]

    return walk(specs, layouts)


def fake_params(cfg, device):
    """The parameter tree (transformer.param_template's shapes and dtypes)
    as empty tensors on `device`: fake inside fake_mode."""
    return tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                         transformer.param_template(cfg))


def lower_step(cfg, cell: ShapeCell, mesh=None, device="cuda", microbatch: int = 0,
               enc_seq: int = 4096):
    """Run one step of `cfg` at `cell`'s shapes on fake tensors and return
    its counts (costs.measure's record, plus n_micro for a train step). A
    mesh must span a fake process group (`fake_world`); its model axis must
    be 1.

    A train step is launch/steps.make_train_step's with cfg's optimizer and
    remat; `microbatch` (global rows a microbatch, 0 for none) splits it
    into global_batch // microbatch microbatches; on a mesh, the data
    parallel gradient reduction of train/train_loop.DataParallel. Prefill
    and decode are make_serve_steps'."""
    dev = _device(device)
    shd.enable_constraints(mesh)  # NotImplementedError for a model axis wider than 1
    try:
        if cell.kind == "train" and dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "a fake-CUDA train step needs PyTorch built for CUDA with a card (autograd "
                "asks the device for a guard); pass device='cpu' for the CPU path"
            )
        with fake_mode():
            if cell.kind == "train":
                n_micro = 1
                if microbatch and microbatch < cell.global_batch:
                    n_micro = cell.global_batch // microbatch
                ranks = 1 if mesh is None else shd.axis_size(mesh, shd._batch_axes(mesh))
                local_mb = cell.global_batch // ranks // n_micro if n_micro > 1 else 0
                dp = None if mesh is None else DataParallel(mesh, cell.global_batch, local_mb)
                step_fn, opt, _ = steps_mod.make_train_step(
                    cfg, microbatch=local_mb, device=dev,
                    grad_sync=None if dp is None else dp.sync,
                )
                params = fake_params(cfg, dev)
                state = opt.init(params, device=dev)
                batch = _empty(make_input_specs(cfg, cell, enc_seq), dev, mesh)
                step = torch.zeros((), dtype=torch.int64, device=dev)
                _, rec = costs_mod.measure(step_fn, params, state, batch, step, mesh=mesh)
                rec["n_micro"] = n_micro
            else:
                prefill_step, decode_step = steps_mod.make_serve_steps(cfg, device=dev)
                params = fake_params(cfg, dev)
                batch = _empty(make_input_specs(cfg, cell, enc_seq), dev, mesh)
                fn = prefill_step if cell.kind == "prefill" else decode_step
                _, rec = costs_mod.measure(fn, params, batch, mesh=mesh)
    finally:
        shd.enable_constraints(None)
    return rec


def lower_cell(arch: str, shape: str, multi_pod: bool, mesh_override=None, device="cuda"):
    """Dry-run one cell; returns its record.

    mesh_override: (shape tuple, axes tuple), a mesh in place of the
    production one (`launch/mesh.make_production_mesh`); the process becomes
    rank 0 of a fake group of the mesh's size for the call."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    shape_axes = mesh_override or mesh_mod.production_shape(multi_pod)
    size = math.prod(shape_axes[0])
    dev = _device(device)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": mesh_tag(shape_axes[0]) if mesh_override else _mesh_tag(multi_pod),
        "devices": size, "kind": cell.kind, "device": dev.type,
    }
    t0 = time.time()
    with fake_world(size):
        mesh = mesh_mod.make_mesh(*shape_axes, device_type=dev.type)
        rec.update(lower_step(cfg, cell, mesh, dev, MICROBATCH.get(arch, 64)))
    rec["run_s"] = round(time.time() - t0, 1)
    _print(rec)
    return rec


def _print(rec):
    coll = ", ".join(f"{k}:{v['count']}x/{v['bytes'] / 2**20:.1f}MiB"
                     for k, v in rec["collectives"].items() if v["count"])
    print(f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}] run={rec['run_s']}s "
          f"flops={rec['hlo_flops']:.3e} bytes={rec['hlo_bytes']:.3e} "
          f"temp={rec['temp_size_in_bytes'] / 2**30:.2f}GiB "
          f"args={rec['argument_size_in_bytes'] / 2**30:.2f}GiB")
    print("  collectives:", coll or "none")


def run_reservoir_dryrun(multi_pod: bool, variant: str = "base", n_steps: int = 100,
                         device="cuda"):
    """The paper's own workload on the production mesh: sharded ensemble
    integration of N = 16 384 oscillators, E = 8 192 lanes, n_steps RK4
    steps in f32 (E over the data axes, N over "model").

    Variants, the reference's:
      base        N over model, an f32 all-gather of m^x per stage
      bf16gather  the same with a bf16 all-gather (half the bytes)
      eonly       E over every axis, W whole on each rank: no collective
    """
    shape, axes = mesh_mod.production_shape(multi_pod)
    ens_axes = axes[:-1]
    kw = dict(model_axis="model")
    if variant == "bf16gather":
        kw["gather_dtype"] = torch.bfloat16
    elif variant == "eonly":
        ens_axes, kw["model_axis"] = axes, None
    elif variant != "base":
        raise ValueError(f"unknown variant {variant!r}")
    size = math.prod(shape)
    dev = _device(device)
    rec = {
        "arch": "sto-reservoir", "shape": f"n16384-e8192-{variant}", "mesh": _mesh_tag(multi_pod),
        "devices": size, "kind": "reservoir", "device": dev.type, "n_steps": n_steps,
    }
    t0 = time.time()
    with fake_world(size):
        mesh = mesh_mod.make_mesh(shape, axes, device_type=dev.type)
        with fake_mode():
            lowered = lower_sharded_ensemble(
                mesh, n=16_384, e=8_192, dt=1e-11, n_steps=n_steps, ensemble_axes=ens_axes,
                dtype=torch.float32, device=dev, **kw,
            )
            _, counts = costs_mod.measure(lowered.func, *lowered.args, mesh=mesh,
                                          **lowered.keywords)
        rec.update(counts)
    rec["run_s"] = round(time.time() - t0, 1)
    _print(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reservoir", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "bf16gather", "eonly"])
    ap.add_argument("--mesh-shape", default=None, metavar="DATAxMODEL",
                    help="an LM cell's mesh over (data, model) in place of the production "
                         "mesh, e.g. 4x1 (a model axis above 1 waits on ROADMAP item 13b)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    override = None
    if args.mesh_shape:
        override = (tuple(int(n) for n in args.mesh_shape.split("x")), ("data", "model"))
        meshes = [False]

    if args.reservoir:
        for mp in meshes:
            rec = run_reservoir_dryrun(mp, args.variant, device=args.device)
            suffix = "" if args.variant == "base" else f"_{args.variant}"
            path = OUT_DIR / f"sto-reservoir{suffix}_{_mesh_tag(mp)}.json"
            path.write_text(json.dumps(rec, indent=1))
            print(json.dumps(rec))
        return

    if args.all:
        jobs = [(a, s) for a in list_configs() for s, ok in cells_for(get_config(a)).items() if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape)]

    failures = []
    for arch, shape in jobs:
        for mp in meshes:
            tag = mesh_tag(override[0]) if override else _mesh_tag(mp)
            path = OUT_DIR / f"{arch}_{shape}_{tag}.json"
            if path.exists() and not args.force:
                print(f"skip cached {path.name}")
                continue
            try:
                rec = lower_cell(arch, shape, mp, mesh_override=override, device=args.device)
                path.write_text(json.dumps(rec, indent=1))
            except Exception as e:  # noqa: BLE001 (a failing cell is reported, the sweep goes on)
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAIL [{arch} x {shape} x {tag}]: {e}")
                traceback.print_exc(limit=5)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested cells ran OK")


if __name__ == "__main__":
    main()
