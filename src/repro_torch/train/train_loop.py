"""Fault-tolerant training loop (the reference's train/train_loop.py).

  - build the train step (launch/steps.make_train_step) on the device,
  - stream the index-based data pipeline (any rank can compute any shard),
  - checkpoint every `ckpt_every` steps (atomic commit) and RESUME from the
    latest checkpoint on startup: a crashed run relaunched with the same
    command continues from the last checkpoint,
  - write a heartbeat file every step (the watchdog fences a run whose
    heartbeat stalls, train/watchdog.py),
  - optional failure injection (tests exercise the restart path).

Initial parameters come from `build_model(cfg, device).init(0)` (a torch
generator), where the reference draws from PRNGKey(0): the two packages
start from different weights unless the port resumes from a reference
checkpoint (train/checkpoint.py reads either package's).

A mesh (`train(cfg, loop, mesh=DeviceMesh)`) splits the batch over its
batch axes and, where its "model" axis is wider than 1, the model over that
axis (tensor parallel: distributed/tensor_parallel.py; every arch, and a
config whose widths the axis does not divide NotImplementedError before any
collective). Every model rank of a batch coordinate takes the same rows;
its parameters and optimizer state are its blocks (sharding.param_specs /
the optimizer's state_specs), from the one-rank init's draws or sliced from
a whole-leaf checkpoint. Each rank computes its slice of the global batch (`batch_specs`' layout for the
tokens: rows over ("pod", "data"), or over "data", or replicated where the
axes do not divide the batch), weights its loss and gradients by its mask
sum over the global mask sum, and the gradients are summed over the batch
axes' groups (all_reduce on the mesh's groups, never the default group):
the global batch's loss and gradient, within f32 rounding of one process.
Over a batch axis the layout replicates, the sum is divided by its size.
The weighting and the sums run in f32 whatever the gradients' dtype. With
`microbatch` below the global batch, each rank's rows must be whole
microbatches (ValueError otherwise, before any collective), and a rank is
weighted by its share of the rows: the sum is then the reference's mean of
every microbatch's mean.
The gradient sums run over the batch axes only: a replicated leaf's
gradient is whole, and bit-identical, on every model rank. Every rank then
applies the same update to its blocks. Rank 0 writes checkpoints (in the
reference's whole-leaf format: the ranks of its model group gather each
leaf over "model", one leaf at a time) and the heartbeat, behind a barrier
over every mesh dim; every rank restores its blocks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer
from repro_torch.models.transformer import TensorSpec
from repro_torch.train import checkpoint as ckpt_mod


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep_ckpts: int = 3
    microbatch: int = 0
    optimizer: Optional[str] = None
    grad_compression: str = "none"
    lr: float = 3e-4
    warmup: int = 50
    data_seed: int = 0
    fail_at_step: Optional[int] = None  # failure injection (tests)
    resume: bool = True


#: all-reduces issued by data-parallel steps in this process (a step's mask
#: sum unless microbatched, then its loss and every gradient leaf, per batch
#: axis)
COLLECTIVES = {"all_reduce": 0}


class DataParallel:
    """A rank's share of a global batch on a DeviceMesh, and the gradient
    reduction over its batch axes (every model rank of a batch coordinate
    takes the same rows)."""

    def __init__(self, mesh, global_batch: int, microbatch: int = 0):
        sizes = shd.axis_sizes(mesh)
        self.mesh = mesh
        layout = shd.batch_specs(mesh, {"tokens": TensorSpec((global_batch, 1), torch.int32)})
        entry = layout["tokens"][0]
        split = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        count = 1
        for a in split:
            count *= sizes[a]
        rows = global_batch // count
        self.microbatched = bool(microbatch) and microbatch < global_batch
        if self.microbatched and rows % microbatch:
            raise ValueError(
                f"a global batch of {global_batch} rows over {count} rank(s) gives each "
                f"{rows} rows, not a multiple of microbatch {microbatch}")
        self.row_share = rows / global_batch
        coord = mesh.get_coordinate()
        names = tuple(mesh.mesh_dim_names)
        index = 0
        for a in split:  # row-major over the layout's axes, as api/sharded._block
            index = index * sizes[a] + int(coord[names.index(a)])
        self.batch_slice = slice(index * rows, (index + 1) * rows) if split else None
        self.split = [mesh.get_group(a) for a in split]
        self.replicated = [(mesh.get_group(a), sizes[a])
                           for a in shd._batch_axes(mesh) if a not in split]
        self.writer = dist.get_rank() == 0
        # the ranks of the writer's model group, which gather a checkpoint's leaves
        self.gathers = all(int(coord[names.index(a)]) == 0 for a in shd._batch_axes(mesh))

    def _all_reduce(self, t: torch.Tensor, group) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES["all_reduce"] += 1

    def _reduce(self, t: torch.Tensor, groups, weight=1.0, n: int = 1) -> None:
        """t <- (sum over `groups` of t * weight) / n, in place, the
        arithmetic and the sums in f32."""
        f = t.float()  # t itself when t is f32
        f.mul_(weight)
        for g in groups:
            self._all_reduce(f, g)
        f.div_(n)
        if f is not t:
            t.copy_(f)

    def sync(self, loss, grads, batch):
        """The global batch's loss and gradients from this rank's, in place."""
        vals = [loss] + tree.leaves(grads)
        if self.split:
            if self.microbatched:  # the mean of every microbatch's mean
                weight = self.row_share
            else:
                mask = batch.get("loss_mask")
                msum = (torch.ones_like(batch["labels"], dtype=torch.float32) if mask is None
                        else mask.float()).sum()
                total = msum.clone()
                for g in self.split:
                    self._all_reduce(total, g)
                weight = msum / torch.clamp(total, min=1.0)
            for t in vals:
                self._reduce(t, self.split, weight=weight)
        for g, n in self.replicated:
            for t in vals:
                self._reduce(t, [g], n=n)
        return loss, grads

    def barrier(self) -> None:
        """A barrier over every rank of the mesh: one over each mesh dim in
        turn (orthogonal groups)."""
        for a in self.mesh.mesh_dim_names:
            dist.barrier(group=self.mesh.get_group(a))


def train(cfg: ModelConfig, loop: LoopConfig, mesh=None, device=None) -> List[Dict[str, float]]:
    """Train `cfg` for loop.total_steps (resuming from loop.ckpt_dir's
    latest checkpoint) on `device` ("cuda" by default; raises without a card
    unless device="cpu"); returns [{"step", "loss", "grad_norm"}] for the
    steps this call ran. The batches are SyntheticTokens, so an
    encoder-decoder arch (whisper: no encoder frames) raises ValueError at
    its first step."""
    dev = resolve_device(device)
    tp.check_supported(cfg, mesh)
    dp = None if mesh is None else DataParallel(mesh, loop.global_batch, loop.microbatch)
    train_step, opt, model = steps_mod.make_train_step(
        cfg,
        optimizer=loop.optimizer,
        microbatch=loop.microbatch,
        grad_compression=loop.grad_compression,
        lr=loop.lr,
        warmup=loop.warmup,
        total_steps=max(loop.total_steps, 100),
        device=dev,
        grad_sync=None if dp is None else dp.sync,
        mesh=mesh,
    )
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
                                      global_batch=loop.global_batch, seed=loop.data_seed))
    writer = dp is None or dp.writer
    gathers = dp is None or dp.gathers
    params_t = transformer.param_template(cfg)
    opt_t = opt.init(params_t, device="meta")
    layouts = None
    if tp.axis_of(mesh) is not None:
        pspecs = shd.param_specs(mesh, params_t)
        layouts = {"params": pspecs, "opt_state": opt.state_specs(mesh, pspecs, params_t)}

    # --- init or resume -----------------------------------------------------
    start_step = 0
    resumed = False
    if loop.resume and ckpt_mod.latest_step(loop.ckpt_dir) is not None:
        params, opt_state, _, start_step = ckpt_mod.restore_checkpoint(
            loop.ckpt_dir, None, params_t, opt_t, device=dev, mesh=mesh, layouts=layouts)
        start_step += 1  # the checkpoint stores the completed step
        resumed = True
    else:
        params = model.init(0)
        opt_state = opt.init(params, device=dev)

    hb_path = Path(loop.ckpt_dir) / "heartbeat.json"
    hb_path.parent.mkdir(parents=True, exist_ok=True)

    def save(step, extra):
        if gathers:
            ckpt_mod.save_checkpoint(loop.ckpt_dir, step, params, opt_state, extra=extra,
                                     keep=loop.keep_ckpts, mesh=mesh, layouts=layouts,
                                     write=writer)
        if dp is not None:
            dp.barrier()

    history: List[Dict[str, float]] = []
    for step in range(start_step, loop.total_steps):
        if loop.fail_at_step is not None and step == loop.fail_at_step and not resumed:
            raise RuntimeError(f"injected failure at step {step}")
        batch = to_device(data.batch(step), dev, None if dp is None else dp.batch_slice)
        step_t = torch.tensor(step, dtype=torch.int32, device=dev)
        params, opt_state, metrics = train_step(params, opt_state, batch, step_t)
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        history.append(rec)
        if writer:
            hb_path.write_text(json.dumps({"step": step, "t": time.time()}))
        if loop.log_every and step % loop.log_every == 0 and writer:
            print(f"step {step:6d}  loss {rec['loss']:.4f}  |g| {rec['grad_norm']:.3f}", flush=True)
        if loop.ckpt_every and (step + 1) % loop.ckpt_every == 0:
            save(step, {"data_seed": loop.data_seed, "loop_step": step})
    # final checkpoint
    if loop.ckpt_every:
        save(loop.total_steps - 1, {"data_seed": loop.data_seed})
    return history
