"""Checkpoint / restart in the reference's on-disk format.

One directory per step:
    manifest.json   step, names, dtypes, shapes, extra: LOGICAL state only,
                    no device layout
    arrays.npz      the flattened leaves, gathered on the host

The format is the reference's (train/checkpoint.py there), so a checkpoint
written by either package restores in the other: leaves in jax's flattening
order (sorted dict keys, repro_torch.tree) of {"params": ..., "opt_state":
...}, named in jax.tree_util.keystr form
("['params']['stack'][0]['mixer']['wq']['kernel']"), array `a{i}` for leaf
i, dtypes by numpy's names ("bfloat16", "float32"), a bf16 leaf stored as
its uint16 bits.

The write is crash-safe: into `.tmp_step_XXXXXXXX`, the manifest fsynced,
then an atomic rename, so a partly written checkpoint is never visible
under its final name; `keep` garbage-collects the oldest steps.

The format holds whole leaves under any mesh, so a checkpoint stays readable
by either package and under any layout. Data parallel, every rank holds
every leaf: one rank writes (train_loop.py), every rank restores the whole
tree. On a model axis wider than 1 (`mesh`, `layouts`: the {"params",
"opt_state"} layout tree), the ranks of the writer's model group gather
each leaf over "model" in turn (one whole leaf on the card at a time) and
the writer writes; every rank restores its blocks, each leaf sliced on the
host.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp


def _dtype_name(dtype) -> str:
    """numpy's name for a torch dtype ("bfloat16", "float32", "int32")."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str, dev) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _names(params, opt_state):
    flat = tree.leaves_with_path({"params": params, "opt_state": opt_state})
    return [tree.keystr(p) for p, _ in flat], [leaf for _, leaf in flat]


def save_checkpoint(
    ckpt_dir: str | Path,
    step: int,
    params,
    opt_state,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
    mesh=None,
    layouts=None,
    write: bool = True,
) -> Optional[Path]:
    """Write a checkpoint of whole leaves; with `layouts` on a mesh, this
    rank's blocks gathered over "model" leaf by leaf (every rank of the
    model group calls it; only write=True writes, the others return None)."""
    names, leaves = _names(params, opt_state)
    if layouts is not None:
        specs = tree.leaves(layouts)
        arrays = {f"a{i}": _to_numpy(tp.gather_leaf(leaf, spec, mesh))
                  for i, (leaf, spec) in enumerate(zip(leaves, specs))}
    else:
        arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    if not write:
        return None
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [_dtype_name(leaf.dtype) for leaf in leaves],
        "shapes": [list(arrays[f"a{i}"].shape) for i in range(len(leaves))],
        "extra": extra or {},
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit

    # GC old checkpoints
    steps = sorted(d for d in ckpt_dir.glob("step_*") if d.is_dir())
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore_checkpoint(ckpt_dir: str | Path, step: Optional[int], params_template,
                       opt_template, device=None, mesh=None, layouts=None):
    """(params, opt_state, extra, step) from the checkpoint of `step` (the
    latest when None), every leaf on `device` ("cuda" by default; raises
    without a card unless device="cpu"); with `layouts` on a mesh, this
    rank's block of every leaf. The templates (tensors or TensorSpecs) give
    the tree structure; their names must be the manifest's."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    names, _ = _names(params_template, opt_template)
    if names != manifest["names"]:
        raise ValueError(f"checkpoint/model tree mismatch in {d}")
    specs = None if layouts is None else tree.leaves(layouts)
    leaves = []
    with np.load(d / "arrays.npz") as data:
        for i, (name, dt, shp) in enumerate(zip(names, manifest["dtypes"], manifest["shapes"])):
            arr = data[f"a{i}"]
            if list(arr.shape) != shp:
                raise ValueError(f"{name}: stored shape {arr.shape}, manifest {shp}")
            if specs is None:
                leaves.append(_from_numpy(arr, dt, dev))
            else:
                whole = _from_numpy(arr, dt, "cpu")
                leaves.append(tp.block(whole, specs[i], mesh).contiguous().to(dev))
    state = tree.unflatten({"params": params_template, "opt_state": opt_template}, leaves)
    return state["params"], state["opt_state"], manifest["extra"], step
